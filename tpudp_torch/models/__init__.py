"""Models of the port: GPT-2 and LLaMA with their KV-cached decode path,
VGG, ResNet and the Vision Transformer (ViT)."""
