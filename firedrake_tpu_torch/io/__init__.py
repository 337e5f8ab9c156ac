from .vtk_output import VTKFile, File

__all__ = ["VTKFile", "File"]
