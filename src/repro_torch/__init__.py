"""PyTorch/CUDA port of the Victima reproduction (``repro``).

Module names mirror ``repro`` so each counterpart is easy to find.  The
package imports torch and numpy, never jax and nothing of ``repro``; the
JAX package stays the reference its tests are held against.
"""
