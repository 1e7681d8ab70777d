"""Shuffle: Spark's murmur3 row hash, the partitioners of a repartition,
and the host shuffle (port of ``spark_rapids_tpu/shuffle``): the TPAK wire
format (serializer.py), the MULTITHREADED file-backed manager (manager.py),
and the P2P mode (p2p.py) over its catalogs, transport, client/server
protocol and heartbeat discovery. The single-device split and the route
choice live in execs/exchange.py."""
