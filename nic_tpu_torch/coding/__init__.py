"""Entropy coding of the port: rANS (``csrc/rans.cpp``), CDF tables, the
bitstream container, the hyperprior codec and the bits-back (BB-ANS) codec."""
