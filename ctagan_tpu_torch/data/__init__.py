"""Host side of the port, in numpy: the DICOM codec, the dual-window
preprocessing, synthetic slices and corpora, the dual-window dataset and
the prefetching loader; the offline corpus stage: ``corpus`` (the tree walk,
pair repairs, patient split, list files, statistics and its CLI, ``python
-m ctagan_tpu_torch.data.corpus``) and ``registration`` (each patient's CTA
registered onto the NCCT and written back, its demons on the card)."""
