"""fci_sigma.roofline.<cells>: the matrix-free FCI product's hand kernels
(csrc/fci_sigma.cu: the beta gather and the alpha scatter of each block)
against their roofline over a traced stretch: the sum over their launches of
the least time, the larger of the bytes each launch must move once at 3.35
TB/s and its operations at 34 TFLOP/s (an H100 SXM's HBM rate and its FP64
rate without tensor cores, NVIDIA's data sheet: the kernels' sign products
and adds are scalar float64), over the two kernels' device time in the
trace. Launches come from the program's counter by
(kernel, na, nb, b, npair, nlink): alpha and beta strings, rows of the
block, orbital pairs, links of an alpha string."""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = 34e12
COUNTERS = ["nbed_tpu_torch.ops.fci_sigma:LAUNCHES_BY_SHAPE"]
KERNEL = "fci_sigma_"


def launch_bytes(key) -> int:
    """Bytes one launch must move once: the gather writes Y (b, npair, nb)
    and reads the block's rows of C and its int32 table (npair, nb); the
    scatter reads the block's Z (b, nlink, nb) and its table (na, nlink),
    and reads and writes sigma (na, nb)."""
    kind, na, nb, b, npair, nlink = key
    if kind == "fci_sigma_gather":
        return 8 * b * npair * nb + 8 * b * nb + 4 * npair * nb
    return 8 * b * nlink * nb + 4 * na * nlink + 16 * na * nb


def launch_ops(key) -> int:
    """Floating-point operations of one launch: the gather's one sign per
    element written, the scatter's one add per element of Z read."""
    kind, na, nb, b, npair, nlink = key
    return b * (npair if kind == "fci_sigma_gather" else nlink) * nb


def least_seconds(key, launches) -> float:
    return launches * max(launch_bytes(key) / HBM_BYTES_PER_S,
                          launch_ops(key) / PEAK_FLOP_PER_S)


def read(run):
    if run.trace is None:
        return None
    device_s = run.trace.kernel_s(KERNEL)
    launches = run.counter(COUNTERS[0], "trace")
    if device_s <= 0 or not launches:
        return None
    return 100.0 * sum(least_seconds(k, n) for k, n in launches.items()) / device_s
