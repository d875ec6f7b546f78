"""Host ms a batch in the ingest driver (pipeline/extract.py's batched
embedder, the store and the DB): the wall time of each flush less the wall
time of the extractor's embed inside it, from the benchmark's spans, over
the window's batches."""


def read(r):
    flush = r["spans"].get("embedder.flush", [])
    embed = r["spans"].get("extractor.extract_image_features", [])
    if not flush or len(flush) != len(embed):
        return None
    return 1e3 * (sum(flush) - sum(embed)) / len(flush)
