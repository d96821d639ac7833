"""The window-ELL planner (:mod:`.plan`, NumPy) and its device kernels
(:mod:`.window_ell`, CUDA through :mod:`._build`)."""
