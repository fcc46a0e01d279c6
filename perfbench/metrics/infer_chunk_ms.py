"""``DeepFrontend.infer_chunk``'s CUDA-event time, mean per chunk over the
window's chunks that were not profiled (layer: the networks)."""


def read(run):
    ms = run.spans.per_chunk_ms("infer_chunk", skip=run.traced) if run.spans else {}
    return sum(ms.values()) / len(ms) if ms else None
