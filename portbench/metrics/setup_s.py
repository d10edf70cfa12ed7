"""``setup_s``: seconds from the process's start to the window's: torch
and the card, the twin loaded (generated in a checkout's first run), the
trainer, the checked rounds and one warm-up chunk; in a first run also
the kernels' nvcc build (host clock)."""


def read(run):
    return run.setup_s
