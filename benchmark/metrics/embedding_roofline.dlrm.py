"""embedding_roofline.dlrm (%; layer: kernels): the share of their
roofline of the three kernels that DLRM's bags and table update run: the
sum over the traced call's steps of each kernel's bound a step
(``benchmark/models/dlrm.py`` ``embedding_work``: the row gather of every
id, the sparse segment sum of the pooled gradient into the distinct rows,
and row-wise Adagrad over those rows, its bytes from the port's counter of
the ids read and the distinct rows touched over the untraced window, at
3.35 TB/s) over the device time of the kernels that bear their names.
Nothing read where no such kernel ran or the port counted nothing."""

from benchmark import trace

#: the kernels' names in the trace: the gather's; the sparse segment sum's
#: key preparation, CUB's radix sort, the run flags, CUB's scan, the
#: numbering, the chunk sums and carries; the update's
KERNELS = ("row_gather_kernel", "prep_keys_sparse", "RadixSort",
           "run_starts", "DeviceScan", "compact_runs", "segment_chunks",
           "segment_carry", "rowwise_adagrad")


def read(s: dict):
    seconds = trace.family_seconds(s, KERNELS)
    work = s["work"].get("embedding")
    if not seconds or not work:
        return None
    bound = sum(trace.bound_s(b, f) for b, f in work) * s["steps"]
    return 100.0 * bound / seconds
