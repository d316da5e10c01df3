from .synthetic import hki_series, make_queries_1d, tweet_latitudes

__all__ = ["hki_series", "make_queries_1d", "tweet_latitudes"]
