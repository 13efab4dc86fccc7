"""Experiment presets (the paper's §7.1 synthetic configurations)."""
