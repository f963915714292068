"""Hough circles and lines, and circle erasure (kernels K2 and K3, the
greedy selection and the accumulator A live in rescore_cuda.py,
radius_cuda.py, greedy_cuda.py and accumulator_cuda.py)."""
