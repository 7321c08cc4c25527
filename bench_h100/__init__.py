"""The H100 benchmark of the PyTorch port (`python3 bench_h100/run.py`)."""
