"""VGGT-1B teacher: DINOv2 patchifier, alternating-attention aggregator,
camera / depth / point / track heads (counterpart of gd3d/models/vggt/).
Parameter names follow the facebook/VGGT-1B state dict."""
