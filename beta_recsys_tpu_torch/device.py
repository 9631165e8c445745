"""Device selection without a silent fallback."""

import torch


def resolve_device(device=None):
    """``None`` means the GPU; it raises when CUDA is absent. Any other value
    goes through ``torch.device`` as given (``"cpu"`` is the caller's choice,
    never a fallback)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: beta_recsys_tpu_torch runs on the GPU by "
                "default; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def fp32_matmuls():
    """Keep float32 products in full float32 on the card (no TF32), so the
    port's numbers stay comparable with the float32 reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
