from heatflow_tpu_torch.io.csvio import (read_gradient_csv, read_watcher_csv,
                                         write_gradient_csv,
                                         write_watcher_csv)
from heatflow_tpu_torch.io.xdmfio import (XDMFTimeSeriesWriter,
                                          read_xdmf_timeseries)

__all__ = [
    "write_watcher_csv",
    "read_watcher_csv",
    "write_gradient_csv",
    "read_gradient_csv",
    "XDMFTimeSeriesWriter",
    "read_xdmf_timeseries",
]
