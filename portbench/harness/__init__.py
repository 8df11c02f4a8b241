"""The benchmark's own machinery: finding the files a cell names
(`spec`), building the port's model from the seed (`model`), the
data-sheet peaks and the trace's arithmetic (`device`), and the
comparison that decides `correct` (`judge`).  `main` runs one cell."""
