"""The verify pass's share of its roofline: the least time of the window's passes
(pbft_bench/roofline.py, counted from the items they carried) over the
device time of the accumulate and verdict kernels in the window, percent."""


def read(record):
    if not record.get("verify_kernel_s") or not record.get("verify_least_s"):
        return None
    return 100.0 * record["verify_least_s"] / record["verify_kernel_s"]
