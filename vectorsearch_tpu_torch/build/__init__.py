from .kmeans import KMeansResult, build_centroids, kmeans, lloyd, sample_init

__all__ = ["KMeansResult", "build_centroids", "kmeans", "lloyd", "sample_init"]
