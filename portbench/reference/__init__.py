"""The plain reference of the benchmark's cells: the DC3D and
DC3DATGeneric networks, their training loss and Adam, the chunk-wire
scan prep and the post stage, written from the published description
(DIAGNijmegen bodyct-dram; arXiv:2105.11748) in plain PyTorch, float32,
with TF32 off. It imports nothing of the program (dram_tpu_torch), of
jax or of the JAX package, and takes only the inputs and weights the
harness made: it works out again whatever the program derives from them
(the chunk wire, folded BatchNorm, the post stage).

A network is found by its configuration's MODEL method (`forward_for`):
DC3D and DC3DATGeneric in nets.py; any other in the module of this
package that lists the method in its METHODS tuple and defines
`forward(x, P, model_cfg, train, q=exact, new_stats=None)` -> (dense,
refined) logits, as nets.forward does."""

import contextlib
import importlib
import pkgutil

import torch

NETS = ("models.DC3D", "models.DC3DATGeneric")


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


def forward_for(model_cfg):
    """The reference's forward of the configuration's MODEL method:
    nets.forward for NETS, else that of the module of this package that
    declares the method in METHODS. Raises NotImplementedError for a
    method no module declares."""
    method = model_cfg["method"]
    if method in NETS:
        from .nets import forward
        return forward
    for info in pkgutil.iter_modules(__path__):
        mod = importlib.import_module(f"{__name__}.{info.name}")
        if method in getattr(mod, "METHODS", ()):
            return mod.forward
    raise NotImplementedError(method)
