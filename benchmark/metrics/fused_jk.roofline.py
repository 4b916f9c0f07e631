"""fused_jk.roofline.<cells>: the fused J/K kernel's share of its roofline
over a traced stretch: the sum over its launches of the least time, the
larger of the bytes each launch must move once (both supermatrices, the
densities, the output) at 3.35 TB/s and its 6 B R M operations at 67
TFLOP/s (an H100's HBM rate and its FP64 tensor-core and FP32 rates,
NVIDIA's data sheet), over the kernel's device time in the trace.
Launches come from the program's counter by (dtype, M, R, B): columns,
rows per lane, lanes."""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = 67e12
COUNTERS = ["nbed_tpu_torch.ops.jk:LAUNCHES_BY_SHAPE"]
_WORD = {"fused_jk_f64": 8, "fused_jk_f32": 4}


def least_seconds(key, launches) -> float:
    kind, m, r, b = key
    by_bytes = (2 * b * r * m + 2 * b * m + 3 * b * r) * _WORD[kind] / HBM_BYTES_PER_S
    by_ops = 6 * b * r * m / PEAK_FLOP_PER_S
    return launches * max(by_bytes, by_ops)


def read(run):
    if run.trace is None:
        return None
    device_s = run.trace.kernel_s("fused_jk")
    launches = run.counter(COUNTERS[0], "trace")
    if device_s <= 0 or not launches:
        return None
    return 100.0 * sum(least_seconds(k, n) for k, n in launches.items()) / device_s
