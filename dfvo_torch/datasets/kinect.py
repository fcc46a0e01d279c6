"""Kinect captures in the TUM RGB-D layout.

Counterpart of ``dfvo_tpu/datasets/kinect.py``: Kinect's factory
intrinsics at 1920x1080, delivered at 640x480 and rescaled to the
configured size; the keyframe trajectory as the pose list; frames named by
``int(timestamp / 0.1)``. That float64 expression truncates (0.3 / 0.1
gives 2), and the file names follow it.
"""

from .tum import TUM

# factory intrinsics at 1920x1080, delivered at 640x480
_KINECT_PARAMS = [972.34, 532.64, 1032.66, 1033.17]  # cx, cy, fx, fy
_RAW = (1080.0, 1920.0)
_DELIVERED = (480.0, 640.0)


class Kinect(TUM):
    pose_file_name = "keyframe_trajectory_mono.txt"

    def get_intrinsics_param(self):
        cx, cy, fx, fy = _KINECT_PARAMS
        # raw -> delivered -> configured size
        cx = cx / _RAW[1] * _DELIVERED[1]
        cy = cy / _RAW[0] * _DELIVERED[0]
        fx = fx / _RAW[1] * _DELIVERED[1]
        fy = fy / _RAW[0] * _DELIVERED[0]
        sy = self.cfg.image.height / _DELIVERED[0]
        sx = self.cfg.image.width / _DELIVERED[1]
        return [cx * sx, cy * sy, fx * sx, fy * sy]

    def image_name(self, timestamp):
        return str(int(timestamp / 0.1))
