"""Conv, MoDE, norm and Gaussian primitives of the port (NDHWC, DHWIO)."""
