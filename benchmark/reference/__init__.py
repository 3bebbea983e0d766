"""The plain reference of the benchmark: the A-TVSNet forward (model), the host-side
preparation of frames and cams (preprocess), the confidence filter and the multi-view
consistency fusion (fusion), the readers of the files a run writes (io) and the weights
loader (weights). Plain PyTorch, NumPy and OpenCV's image codec; it imports nothing of
the program, and the benchmark's tests hold it so (benchmark/tests/test_bench_guard.py).
"""
