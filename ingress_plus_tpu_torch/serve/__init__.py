"""The serve plane: request model, unpacking and normalization, the stream
lane, the wire protocol, the Batcher, serve lanes and the UDS serve loop."""
