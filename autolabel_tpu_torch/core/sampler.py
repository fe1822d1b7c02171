"""Class-balanced pixel index sampling over sparse user annotations.

Counterpart of autolabel_tpu/core/sampler.py (IndexSampler), kept as the
port's own copy. Semantic label convention: 0 is the null/unlabeled
class, 1 is background, 2+ are object classes.

The JAX sampler draws from numpy's global RandomState (np.random.choice);
here the RandomState is an argument whose default is that same global
state, so one seed gives both packages the same draws.
"""
import numpy as np


class IndexSampler:
    """Index of labeled pixels: class id -> image index -> flat pixel ids.
    random_state: the np.random.RandomState the draws come from (numpy's
    global one when None)."""

    def __init__(self, random_state=None):
        self.random_state = random_state
        self.classes = np.array([])
        self.index = {}
        # class id -> per-image probability of sampling that image,
        # proportional to its pixel count for the class.
        self.image_weights = {}
        self.has_semantics = False
        self.image_range = np.array([])

    @property
    def _random(self):
        return np.random if self.random_state is None else self.random_state

    def update(self, semantic_maps):
        """Recompute the index from (n_images, n_pixels) label maps."""
        if semantic_maps.ndim != 2:
            raise ValueError('semantic_maps must be (n_images, n_pixels), '
                             f'got shape {semantic_maps.shape}')
        self.index = {}
        classes = np.unique(semantic_maps)
        self.classes = classes[classes != 0]
        n_images = len(semantic_maps)
        counts = {}
        for class_id in self.classes:
            per_image = {}
            class_counts = np.zeros(n_images)
            for i in range(n_images):
                where = np.flatnonzero(semantic_maps[i] == class_id)
                if where.size:
                    self.has_semantics = True
                    per_image[i] = where
                    class_counts[i] = where.size
            if per_image:
                self.index[class_id] = per_image
                counts[class_id] = class_counts / class_counts.sum()
        self.image_weights = counts
        self.image_range = np.arange(n_images, dtype=int)

    def sample_class(self):
        return self._random.choice(self.classes)

    def sample(self, class_id, count=1):
        """Sample an image (weighted by class pixel count) and pixel ids.

        Returns (image_index, (count,) pixel indices of class_id pixels).
        """
        images = self.index[class_id]
        probabilities = self.image_weights[class_id]
        image_index = self._random.choice(self.image_range, p=probabilities)
        pixel_indices = self._random.choice(images[image_index], count)
        return image_index, pixel_indices

    def semantic_indices(self):
        """Sorted image indices that carry any semantic annotation."""
        indices = set()
        for per_image in self.index.values():
            indices.update(per_image.keys())
        return sorted(indices)
