"""The benchmark of emg3d_tpu_torch on an NVIDIA H100 (``run.py``)."""
