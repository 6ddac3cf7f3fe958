"""The least time for the traced windows' dominance work (``skybench.work``:
bytes over 3.35 TB/s or pairs x d over 67 TFLOP/s, the larger) over the
device time of the port's dominance kernels in them, by name from the
device trace, in percent. Nothing when no such kernel ran."""

# the port's dominance kernels (skyline_tpu_torch/csrc/dominance.cu,
# dominance_rank.cu, cascade.cu), by the names the device trace gives them
DOMINANCE_KERNELS = (
    "summarize_kernel", "dominated_kernel", "predrop_summarize_kernel", "predrop_kernel",
    "rank_summarize_kernel", "rank_dominated_kernel",
    "window_summary_kernel", "window_kernel", "scan_summary_kernel", "cascade_scan_kernel",
)


def read(run):
    if run.trace is None or run.work_floor_s is None:
        return None
    kernel_s = sum(run.trace["kernel_s"].get(k, 0.0) for k in DOMINANCE_KERNELS)
    if kernel_s <= 0:
        return None
    return 100.0 * run.work_floor_s / kernel_s
