"""setup_s: seconds from the process's start to the window's start: imports,
the weights drawn on the card, the engine or training step built, every
kernel loaded (built with nvcc on a checkout's first run) and every shape
the cell uses captured, and the traffic run before the window."""


def read(run):
    return run.setup_s
