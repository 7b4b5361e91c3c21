"""Device time in ATen's scan kernels (the cummax/cummin/cumsum families)
over all device time in the profiled inputs, in %."""

SCAN_KERNELS = (
    "scan_innermost_dim",  # at::native tensor_kernel_scan_innermost_dim*
    "scan_outer_dim",  # at::native tensor_kernel_scan_outer_dim*
    "DeviceScan",  # cub's DeviceScanKernel / DeviceScanInitKernel (cumsum)
    "cumsum",
    "cummax",
    "cummin",
)


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["device_s"]:
        return None
    scan = sum(v for n, v in tr["device_ops"].items()
               if any(k in n for k in SCAN_KERNELS))
    return 100.0 * scan / tr["device_s"]
