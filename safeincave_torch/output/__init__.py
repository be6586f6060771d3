"""Outputs: XDMF/HDF5 field time series and the console/log step table."""
from .xdmf import SaveFields
from .screen import ScreenPrinter

__all__ = ["SaveFields", "ScreenPrinter"]
