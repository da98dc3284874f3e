"""setup_s (s): the process's start to the window's start -- imports, the
weights made and frozen layer by layer, the engine, its warm-up (every
kernel built and loaded, every step shape of the traffic run) and the
traffic's ramp."""


def read(run):
    return run.setup_s
