"""One PyTorch intra-op thread for the port's CPU tests, imported by every
`tests/test_torch_*.py`: the suite runs six pytest-xdist workers on the
machine's cores, so a thread pool in each worker only spins against the
others'."""

import torch

torch.set_num_threads(1)
