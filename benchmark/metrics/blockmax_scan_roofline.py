"""The block-max kernel's share of its roofline: the least time the card
could take for the stage-1 work of every search in the traced window
(benchmark/roofline/blockmax_scan.py), over the kernel's device time in
the trace. Each search of the closed loop launches the kernel once over
its batch; the reader checks the program's launch counter and the trace
against that (layers.traced_share)."""

from benchmark.harness.layers import dispatches, traced_share
from benchmark.roofline import blockmax_scan as op


def _launches() -> int:
    from vearch_tpu_torch.ops.blockmax_scan import int8_blockmax_stage1

    return int8_blockmax_stage1.launches


def start(ctx):
    ctx.state["blockmax_launches"] = _launches()


def read(ctx):
    if ctx.trace is None:
        return None
    seconds = ctx.trace.device_seconds(op.KERNELS)
    launches = _launches() - ctx.state["blockmax_launches"]
    groups = dispatches(ctx.window)
    traced = ctx.trace.count(op.KERNELS)
    scale = traced_share("blockmax_scan_roofline", launches, traced,
                         len(groups))
    if seconds <= 0 or scale is None:
        return None
    live = ctx.data.n - len(ctx.data.deleted)
    indexed = int(ctx.system.index.indexed_count)
    least = sum(op.least_seconds(sum(len(r.rows) for r in g), live,
                                 indexed, ctx.data.dim) for g in groups)
    return 100.0 * least * scale / seconds
