"""Model code: layers, attention, MoE, the layer stack and the facade."""

from repro_torch.models.model import Model

__all__ = ["Model"]
