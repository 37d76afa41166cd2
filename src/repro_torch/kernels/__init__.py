"""Hand-written Hopper kernels of the port, each beside its plain version.

| kernel | replaces | source |
| --- | --- | --- |
| ``runqlat_hist`` | ``repro/kernels/runqlat_hist.py::runqlat_hist_pallas`` | ``csrc/runqlat_hist.cu`` |
"""
