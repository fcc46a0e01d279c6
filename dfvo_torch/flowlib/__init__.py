from .flowlib import flow_to_image

__all__ = ["flow_to_image"]
