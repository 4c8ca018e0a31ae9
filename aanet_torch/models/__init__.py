"""NCHW ``nn.Module``s of the five-stage stereo pipeline."""

from aanet_torch.models.aanet import AANet

__all__ = ["AANet"]
