from cavmd_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from cavmd_tpu_torch.io.gsd import (
    GSDFile,
    GSDWriter,
    HOOMDTrajectory,
    gather_tracker_log,
    open_gsd,
)
from cavmd_tpu_torch.io.text import TableWriter

__all__ = ["GSDFile", "GSDWriter", "HOOMDTrajectory", "gather_tracker_log",
           "open_gsd", "TableWriter", "save_checkpoint", "load_checkpoint"]
