"""The most device memory the program held at once in the window
(``torch.cuda.max_memory_allocated``, reset at the window's start), in
GiB: it sets the largest graph a card can partition."""


def read(run):
    return run.peak_bytes / 2**30
