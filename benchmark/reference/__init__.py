"""The plain reference of the benchmark's output check: plain PyTorch that
imports nothing of the port (``renderer_tpu_torch``), nor jax or the JAX
package."""
