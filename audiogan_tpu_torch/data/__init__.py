"""Host-side data of the port: WAV I/O, the packed int16 corpus, the
deterministic index stream and the synthetic SC09-shaped fixture."""
