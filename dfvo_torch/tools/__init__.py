"""Dataset and export tools: ``python -m dfvo_torch.tools.generate_flow_prediction``
(KITTI flow PNGs from LiteFlowNet), ``generate_kitti_raw_pose`` (KITTI raw
GT poses from OXTS) and ``undistort_robotcar`` (RobotCar frames demosaiced
and undistorted)."""
