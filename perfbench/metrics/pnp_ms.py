"""The deferred ``pnp_fallback``'s CUDA-event time, mean per chunk over the
window's chunks that were not profiled (layer: the geometry's PnP
fallback). Nothing to read where no chunk called it."""


def read(run):
    if not run.spans:
        return None
    ms = run.spans.per_chunk_ms("pnp_fallback", skip=run.traced)
    chunks = [i for i, *_ in run.records if i not in run.traced]
    return sum(ms.values()) / len(chunks) if ms and chunks else None
