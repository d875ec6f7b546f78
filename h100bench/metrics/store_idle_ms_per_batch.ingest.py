"""ms a batch of the traced window's idle time on the card inside the port's
``wise.ingest.store`` spans, where the ingest pipeline writes the batch's
vectors to the feature store (one span a batch): each idle gap counts for
the part of it that the span covers, not whole by the span at its middle;
over the window's batches."""

from h100bench import program_spans


def read(r):
    return program_spans.idle_ms_per_batch(r, "wise.ingest.store")
