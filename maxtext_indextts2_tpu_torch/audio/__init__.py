"""The TTS back end: S2A masked-diffusion sampler, RVQ and the waveform decoder."""
