"""Host data path of the port: encodings, synthetic data, HDF5 stream."""
