"""device_idle_share: the share (%) of the profiled slice in which no
operation ran on the card (one minus the union of the device records'
intervals over the slice's length)."""


def read(run):
    sl = run["slice"]
    if sl is None or sl["seconds"] <= 0:
        return None
    return 100.0 * (1.0 - sl["summary"]["busy_s"] / sl["seconds"])
