from repro_torch.data.synthetic import SyntheticEnv, make_synthetic_env
from repro_torch.data.tokens import TokenPipeline, pipeline_for
from repro_torch.data.yahoo import YahooLikeEnv, make_yahoo_like_env

__all__ = [
    "SyntheticEnv", "make_synthetic_env",
    "TokenPipeline", "pipeline_for",
    "YahooLikeEnv", "make_yahoo_like_env",
]
