"""vtpu_torch: the PyTorch / CUDA port of vtpu for NVIDIA H100 cards.

A tenant's model runs on a slice of one card: an HBM cap and a compute
share, read from the same Allocate env contract as ``vtpu`` and enforced
in the tenant's own process over the shared accounting region that
``native/vtpucore`` implements (``shim``).  The flagship tenant workload
is the Llama-style transformer (``models``), whose fused attention runs
as a hand-written CUDA kernel for Hopper (``ops``).  ``entry.serve`` is
the greedy next-token serving loop that ties them together.

The package imports torch and numpy only; it keeps its own copies of
what it needs from ``vtpu`` and shares nothing with it but the native
region's C source.
"""

__version__ = "0.1.0"
