"""The MBT2018 mean-scale hyperprior and its parts."""
