"""Device time of each fused chunk inside the window (CUDA events around
every graph replay) over its decode steps."""


def read(run):
    w = run.window
    if not w.chunk_ms:
        return None
    return sum(w.chunk_ms) / (len(w.chunk_ms) * w.chunk)
