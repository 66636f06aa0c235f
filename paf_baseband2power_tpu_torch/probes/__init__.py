"""Measurement probes of the spectrometer on the card.

``wide_reshape`` (micro and planes, K11-K12) and ``karatsuba`` (K13): each
probe is a hand-written CUDA kernel beside its plain PyTorch version, and a
``main`` that times it against the port's production spectrometer:

    python -m paf_baseband2power_tpu_torch.probes.wide_reshape [--nfft 1024]
    python -m paf_baseband2power_tpu_torch.probes.karatsuba [--check]

``streaming`` times the production spectrometer's overlap-save carry in
five steps (A-E):

    python -m paf_baseband2power_tpu_torch.probes.streaming [--nfft 1024]

Each runs on the card unless given ``--platform cpu``.
"""
