"""Shuffle: Spark's murmur3 row hash and the partitioners of a
repartition (the single-device split lives in execs/exchange.py)."""
