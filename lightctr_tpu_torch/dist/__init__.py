"""The PS plane's wire and socket service, copied from ``lightctr_tpu/dist``
(partition, elastic checksums, wire codecs, ``ps_server``, heartbeat).
The wire is byte-identical, so port and JAX peers talk to each other."""
