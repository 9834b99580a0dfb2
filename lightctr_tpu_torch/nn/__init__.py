"""Layers of the port: the fully-connected layer (``nn.dense``), exact
single-device attention (``nn.ring_attention.full_attention``), the flash
attention kernel (``nn.flash_attention``), ring attention over a ``seq``
mesh (``nn.ring_attention.ring_self_attention``), and the DL zoo's layers:
convolution (``nn.conv``), max pooling (``nn.pool``), the LSTM
(``nn.lstm``), additive attention (``nn.attention``) and the VAE's
sampling layer (``nn.sample``)."""
