from .vtk_output import VTKFile, File
from .checkpoint import (CheckpointFile, DumbCheckpoint, FILE_CREATE,
                         FILE_READ, FILE_UPDATE)

__all__ = ["VTKFile", "File", "CheckpointFile", "DumbCheckpoint",
           "FILE_CREATE", "FILE_READ", "FILE_UPDATE"]
