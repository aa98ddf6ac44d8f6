"""Model definitions: the Llama-3 decoder (serving and training), the
Mixtral-style MoE family on its trunk, and the vision family (ViT,
ResNet)."""
from ray_tpu_torch.models.resnet import ResNetConfig, resnet_configs
from ray_tpu_torch.models.vit import ViTConfig, vit_configs

__all__ = ["ResNetConfig", "resnet_configs", "ViTConfig", "vit_configs"]
