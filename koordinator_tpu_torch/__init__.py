"""koordinator_tpu_torch: the koordinator-tpu scheduler ported to PyTorch and
CUDA for an NVIDIA H100.

The JAX package (koordinator_tpu) is the reference; this package imports
neither it nor JAX. It mirrors the reference's layout (api/, ops/, models/,
scheduler/, testing/) so each module's counterpart is easy to find. Host
code packs the cluster into numpy arrays; the scheduling round runs on
torch tensors, in a hand-written CUDA kernel (csrc/) on the card and in its
plain torch version on the CPU. Entry points default to device="cuda".
"""
