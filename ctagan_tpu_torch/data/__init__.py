"""Host side of the port, in numpy: the DICOM codec, the dual-window
preprocessing, synthetic slices and corpora, the dual-window dataset and
the prefetching loader."""
