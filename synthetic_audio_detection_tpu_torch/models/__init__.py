"""ResNet backbones, the binary head, the classifier and the BN-folded eval forward."""
