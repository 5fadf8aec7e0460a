"""The SLAM services (counterpart of ``mast3r_slam_tpu/services``): the
pointmap-quality service, the local per-keyframe TSDF refiner and the
global TSDF with its native voxel hash."""
