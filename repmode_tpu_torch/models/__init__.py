"""The MoDE U-Net (eval mode) and its re-parameterized serving net."""
