"""Camera, coefficient formulation and the bounce kernel."""
