from repro_torch.data.synthetic import SyntheticEnv, make_synthetic_env

__all__ = ["SyntheticEnv", "make_synthetic_env"]
