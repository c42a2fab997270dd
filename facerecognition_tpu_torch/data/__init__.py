"""Host-side data: the image decoder's bindings and dataset indexes."""
