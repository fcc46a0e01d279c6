from .kp_selection import KPSelectionSpec, local_bestN

__all__ = ["KPSelectionSpec", "local_bestN"]
