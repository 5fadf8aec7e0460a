"""The viewer (counterpart of ``mast3r_slam_tpu/viz``): the software
renderer on the keyframe buffer's device (``render``), the OpenGL viewer
thread (``viewer``) with its context backends (``glctx``) and control
overlay (``ui``)."""
