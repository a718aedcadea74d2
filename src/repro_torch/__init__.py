"""PyTorch / CUDA port of the Teola reproduction (``repro``).

Module names mirror ``repro``'s. The port imports torch and numpy only;
its entry points (``LLMEngine``, the encoder engines, ``build_engines``)
take ``device=`` and default to ``"cuda"``.

Float32 matrix products and convolutions run in full float32 on the card:
TF32 is switched off here, explicitly, for the whole process.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
