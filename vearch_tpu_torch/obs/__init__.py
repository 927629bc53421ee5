"""Runtime truth layer of the port (the reference's vearch_tpu/obs/):
what the card really holds and does, beside what the perf model says.

- ``quantiles``        fixed-memory P^2 latency sketches
- ``flight_recorder``  post-warmup compile events (builds, new launch
                       shapes; ops/perf_model.py program tracking)
- ``sampler``          device bytes from the caching allocator against
                       the indexes' footprint models
- ``quality``          shadow exact-search recall and index-health drift
- ``accounting``       per-space cost meters and SLO burn rates
- ``errors``           the port's internal-error counter

Nothing here launches device work of its own; the quality monitor's
shadow searches run through the engine.
"""
