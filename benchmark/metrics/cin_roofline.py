"""cin_roofline (%; layer: kernels): the CIN kernels' share of their
roofline in the traced call: the sum over its steps of each layer's forward
(K3f) and backward (K3b) bound (``benchmark/models/xdeepfm.py``
``cin_fwd_work``, ``cin_bwd_work``) over the device time of the kernels
that bear their names. Nothing read where no such kernel ran."""

from benchmark import trace

KERNELS = ("cin_fwd", "cin_bwd")


def read(s: dict):
    seconds = trace.family_seconds(s, KERNELS)
    work = s["work"].get("cin")
    if not seconds or not work:
        return None
    bound = sum(trace.bound_s(b, f) for b, f in work) * s["steps"]
    return 100.0 * bound / seconds
