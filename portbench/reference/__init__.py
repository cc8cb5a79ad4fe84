"""The plain reference of the benchmark's cells: the DC3D and
DC3DATGeneric networks, their training loss and Adam, the chunk-wire
scan prep and the post stage, written from the published description
(DIAGNijmegen bodyct-dram; arXiv:2105.11748) in plain PyTorch, float32,
with TF32 off. It imports nothing of the program (dram_tpu_torch), of
jax or of the JAX package, and takes only the inputs and weights the
harness made: it works out again whatever the program derives from them
(the chunk wire, folded BatchNorm, the post stage)."""

import contextlib

import torch


@contextlib.contextmanager
def exact_f32():
    """float32 matmuls and convolutions without TF32, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
