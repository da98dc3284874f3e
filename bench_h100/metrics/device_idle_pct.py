"""device_idle_pct (%): the share of the profiled slice's wall time
in which no kernel, copy or set ran on the device.  Layer: device."""


def read(run):
    sl = run.slice
    if not sl or sl["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["window_s"])
