from .touch import TouchCalibration, drags_to_impulses, scripted_swirl

__all__ = ["TouchCalibration", "drags_to_impulses", "scripted_swirl"]
