"""Device ops: z-buffer, histogram classification (kernel K1), label fusion,
attention (kernels K2 and K3), 2D components, voting."""
