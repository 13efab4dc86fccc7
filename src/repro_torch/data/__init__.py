from repro_torch.data.synthetic import SyntheticEnv, make_synthetic_env
from repro_torch.data.yahoo import YahooLikeEnv, make_yahoo_like_env

__all__ = [
    "SyntheticEnv", "make_synthetic_env",
    "YahooLikeEnv", "make_yahoo_like_env",
]
