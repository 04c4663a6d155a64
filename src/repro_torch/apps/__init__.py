"""Applications protected by the dependability layer: the paper's 4-D
full-waveform inversion case study (``fwi``, ``fwi_case_study``)."""
