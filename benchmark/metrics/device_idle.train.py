"""device_idle.train (%; layer: device): the share of the traced call's
wall time (host clock, from the call to the synchronise after it) in which
the card ran nothing."""


def read(s: dict):
    if not s["device_ops"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["wall_s"])
