"""The scheduler's queue wait per request over the window: the change of
the accountant's `queue_wait_us` total (obs/accounting.py, charged by
BatchScheduler._run_bucket for every request it dequeues, bound to a
space or not), over the requests answered."""


def _total() -> int:
    from vearch_tpu_torch.obs.accounting import ACCOUNTANT

    return ACCOUNTANT.snapshot()["totals"]["queue_wait_us"]


def start(ctx):
    ctx.state["queue_wait_us"] = _total()


def read(ctx):
    n = len(ctx.window.answered)
    if n == 0:
        return None
    return (_total() - ctx.state["queue_wait_us"]) / 1e3 / n
