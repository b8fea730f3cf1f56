"""vertex_out_ms.audio_rate: host milliseconds a window for the FLAME
decode (K5) of its frames and the copy of its vertices to the host,
synchronised at both ends (traced calls)."""


def read(ctx, run):
    times = run.work.get("vertex_out_ms") or []
    return sum(times) / len(times) if times else None
