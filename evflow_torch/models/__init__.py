"""Models of the port: norms, spiking cells, FireNet and FusedFireNet."""
