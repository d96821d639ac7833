"""The yardstick: frozen copies of the matrix laws, the byte models, the
table of peaks and the plain float64 reference.  Nothing here imports
``tpu_spmv_torch``, ``tpu_spmv`` or ``jax``."""
