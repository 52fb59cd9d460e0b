"""fluctus_tpu_torch — the PyTorch/CUDA port of the fluctus_tpu path tracer.

A second package beside `fluctus_tpu` (the JAX reference), for one NVIDIA
H100. It keeps the JAX package's layout (core/, io/, scene/, accel/, ops/,
integrators/, render/) and imports nothing of it: host code is NumPy and
the standard library, device code is PyTorch plus hand-written CUDA
kernels under csrc/, built at first use.

Main path: render/driver.py::create_session -> render(integrator=
"lockstep"), traced through kernel K1 (ops/traverse_stack.py).
"""

__version__ = "0.1.0"
