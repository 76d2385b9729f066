"""Viewers: offline frames (PPM / AVI), a matplotlib window and a browser
view, all rendered by the ray cast on the sim's device."""

from .live_viewer import LiveViewer
from .offline_viewer import OfflineViewer
from .web_viewer import WebViewer, encode_png

__all__ = ["OfflineViewer", "LiveViewer", "WebViewer", "encode_png"]
