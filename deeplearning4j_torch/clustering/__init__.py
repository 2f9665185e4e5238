"""Clustering + spatial search (the port of ``deeplearning4j_tpu/clustering``;
reference: deeplearning4j-core clustering/ — kmeans/, kdtree/,
vptree/VPTree.java:39, sptree/SpTree.java, quadtree/)."""

from deeplearning4j_torch.clustering.kmeans import KMeansClustering
from deeplearning4j_torch.clustering.kdtree import KDTree
from deeplearning4j_torch.clustering.sptree import QuadTree, SPTree
from deeplearning4j_torch.clustering.vptree import VPTree

__all__ = ["KMeansClustering", "KDTree", "VPTree", "SPTree", "QuadTree"]
