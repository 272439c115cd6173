"""The MBT2018 mean-scale hyperprior, its bits-back variant and their parts."""
