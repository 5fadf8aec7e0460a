"""Multi-device placement (counterpart of ``mast3r_slam_tpu/parallel``):
the device slots and their split and copy helpers (``sharding``), and the
disjoint assignment of frontend, backend and services (``topology``)."""
