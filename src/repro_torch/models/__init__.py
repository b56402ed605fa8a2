"""The LM framework's models: blocks of GQA attention, MLA, Mamba2 SSD or
NFFT kernel attention with a dense MLP or a mixture of experts, the
modality frontends, and the model's training loss and serving forwards."""
