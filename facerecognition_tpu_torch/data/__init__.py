"""Host-side data: the image decoder's bindings, dataset indexes, samplers,
the batch loader, and the training augmentation (which runs on the card)."""
