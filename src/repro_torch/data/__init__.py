from .synthetic import (hki_series, make_queries_1d, make_queries_2d,
                        osm_points, tweet_latitudes)

__all__ = ["hki_series", "make_queries_1d", "make_queries_2d", "osm_points",
           "tweet_latitudes"]
