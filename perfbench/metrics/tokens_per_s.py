"""Output tokens the engine served inside the window over the window's
seconds (host clock at the drains that open and close it)."""


def read(run):
    w = run.window
    return sum(last - first for _, first, last in w.token_spans()) / w.seconds
