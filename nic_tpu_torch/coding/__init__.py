"""Entropy coding of the port: rANS (``csrc/rans.cpp``), CDF tables, the
bitstream container and the hyperprior codec."""
