"""Attention of the port: exact single-device attention
(``nn.ring_attention.full_attention``), the flash attention kernel
(``nn.flash_attention``) and ring attention over a ``seq`` mesh
(``nn.ring_attention.ring_self_attention``)."""
