"""Host side of the serving path: the DICOM codec, the dual-window
preprocessing and the synthetic slices, in numpy."""
