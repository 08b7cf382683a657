"""embedding_roofline (%; layer: kernels): the embedding kernels' share of
their roofline in the traced call: the sum over its steps of each launch's
bound (the row gather S1 and the segment sum K1/K2 of each table,
``benchmark/models/criteo.py`` ``embedding_work``; the larger of bytes over
3.35 TB/s and flops over 67 TFLOP/s) over the device time of the kernels
that bear their names. Nothing read where no such kernel ran."""

from benchmark import trace

#: the kernels' names in the trace: the gather's, and the segment sum's key
#: preparation, CUB's radix sort, chunk sums and carries
KERNELS = ("row_gather_kernel", "prep_keys", "RadixSort", "segment_chunks",
           "segment_carry")


def read(s: dict):
    seconds = trace.family_seconds(s, KERNELS)
    work = s["work"].get("embedding")
    if not seconds or not work:
        return None
    bound = sum(trace.bound_s(b, f) for b, f in work) * s["steps"]
    return 100.0 * bound / seconds
