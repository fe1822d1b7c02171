"""Teacher feature extractors: DINO ViT-S/8, FCN-ResNet50, LSeg with the
CLIP text tower, the scene-trained DemoCLIP, and the offline stand-ins."""
